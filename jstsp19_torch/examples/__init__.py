"""The worked examples of the JAX package's ``examples/``, one module each
under the script's name, on the card unless ``--cpu`` is given
(``python -m jstsp19_torch demo [name] [--cpu]``).

Every module has ``build(device, gen)`` (the problem's draws, as a dict of
tensors, drawn on the CPU generator ``gen`` and moved to ``device``),
``solve(problem)`` (the numbers the script prints, by label:
``_common.labelled``) and ``main(argv)`` (prints the script's lines, with
its labels and formats).  ``TOLERANCE`` holds the classes its numbers are
compared under (``_common.mismatches``) where they differ from the defaults,
each with its measured reason (``CARD_TOLERANCE``, where a module has one,
for the card against the CPU on the port's own draws; ``FLOAT64``, where
float32 roundoff separates the two, to hold them in float64).  Importing a
module runs nothing.
"""

NAMES = ("applications", "basic_gamp", "channel_estimation", "cs_mri", "dictionary_learning", "em_learning",
         "gamp_options", "hyperspectral_unmixing", "impulsive_noise", "large_array_sharded", "matrix_completion",
         "nonlinear_channels", "probit_classification", "rank_one_factorization", "robust_classification", "s_amp",
         "self_calibration", "snipe", "sparse_recovery", "state_evolution", "structured_sparsity")
