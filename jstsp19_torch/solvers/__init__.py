"""Solvers: the soft threshold and the l1 beamspace ADMM, SVT and the
SVT/ADMM matrix completions (``mc_svt``, ``mc_admm``), the proposed ADMM, the
baselines LS, OMP (``omp``, ``omp_gram``, the time-domain ``omp_td``,
MMV-OMP) and CoSaMP, VAMP-GLM with its state evolution, VAMP-SLM, the 45
scalar estimators, the GAMP core (``gamp_est``, ``gamp``, ``amp``,
``amp_est`` with S-AMP, ``fista``, ``sure_amp``), GAMP's state evolution,
the EM solvers (``em_bg_vamp``, ``em_gm_vamp``, ``em_nngm_gamp``), the
turbo solvers with structured supports and amplitudes (``turbo_*``,
``em_turbo_*``, ``markov_fb``) and the bilinear solvers (BiG-AMP and its EM
wrappers, BiG-AMP-PEV and Lite, P-BiG-AMP, HUTAMP, the rank-one fit).

The names the JAX package's ``solvers`` exports and the port has are
exported here under the same names, each imported on first use (the kernel
wrappers import ``solvers.sparse``, so importing every solver here would
make a cycle), except ``gamp``, ``gamp_se`` and ``vamp_slm``: here those
name their modules, where the JAX package rebinds them to the functions.
``bigamp``, ``pbigamp`` and ``hutamp`` are the functions, as in JAX, also
once their modules are imported (``from jstsp19_torch.solvers.bigamp import
…`` and ``importlib.import_module`` reach the modules).
"""
import importlib
import sys
import types

_EXPORTS = {
    **dict.fromkeys(("svt", "mc_svt", "mc_admm"), "lowrank"),
    **dict.fromkeys(("soft_threshold", "sparse_admm"), "sparse"),
    **dict.fromkeys(("proposed_admm", "proposed_admm_angles", "admm_hyperparams"), "admm"),
    **dict.fromkeys(("ls_estimate",), "lsq"),
    **dict.fromkeys(("cosamp", "omp", "omp_gram", "omp_mmv", "omp_td"), "omp"),
    **dict.fromkeys(("CAwgnPrior", "SparsePrior", "CAwgnLikelihood", "AwgnPrior", "SoftThreshPrior",
        "CGMPrior", "LaplacePrior", "UnifPrior", "NNGMPrior", "SNIPEPrior", "EllpPrior", "DiscretePrior",
        "GroupSparsePrior", "ProbitLikelihood", "LogitLikelihood", "RobustProbitLikelihood",
        "RobustLogitLikelihood", "TDistLikelihood", "MultiLogitLikelihood", "PoissonLikelihood",
        "QuantizedLikelihood", "OutlierLikelihood", "AwbgnLikelihood", "TruthReporterPrior",
        "LaplaceLikelihood", "MagnitudeLikelihood", "DiracPrior", "NullPrior", "ElasticNetPrior",
        "NNSoftThreshPrior", "MixPrior", "ConcatPrior", "DiracLikelihood", "MaskedLikelihood",
        "GaussMixLikelihood", "CMultAwgnLikelihood", "HingeLikelihood", "ConcatLikelihood", "BGZeroMeanPrior",
        "EllpDMMPrior", "SoftThreshDMMPrior", "FxnhandlePrior", "MultiSNIPEPrior", "L1Likelihood",
        "NLLikelihood"), "estim"),
    **dict.fromkeys(("cawgn_likelihood_mse", "mc_likelihood_mse", "vamp_glm", "vamp_glm_se", "vamp_mmwave"),
        "vamp"),
    **dict.fromkeys(("fista", "amp", "amp_est", "sure_amp"), "gamp"),
    **dict.fromkeys(("GampOptions", "GampState", "GampEstFin", "gamp_est"), "gamp_full"),
    "vamp_slm_se": "vamp_slm",
    **dict.fromkeys(("EstimInAvg", "AwgnOutAvg", "MCOutAvg", "estim_in_avg", "bg_sampler", "s_transform"),
                    "gamp_se"),
    **dict.fromkeys(("EmGmResult", "EmGmFullResult", "EmNNGMResult", "em_bg_vamp", "em_gm_vamp", "em_nngm_gamp"),
                    "em"),
    **dict.fromkeys(("TurboResult", "turbo_markov_vamp", "turbo_gauss_markov_vamp", "turbo_mrf_vamp"), "turbo"),
    **dict.fromkeys(("EmTurboResult", "EmGaussMarkovResult", "TurboResult3D", "em_turbo_markov_vamp",
                     "em_turbo_gauss_markov_vamp", "turbo_mrf3d_vamp", "turbo_mrf_arb_vamp", "markov_fb"),
                    "turbo_em"),
    **dict.fromkeys(("bigamp", "bigamp_mc", "bigamp_rpca", "em_bigamp_mc", "em_bigamp_dl"), "bigamp"),
    **dict.fromkeys(("BigAmpOptions", "bigamp_pev", "bigamp_lite"), "bigamp_full"),
    **dict.fromkeys(("pbigamp", "em_pbigamp"), "pbigamp"),
    "hutamp": "hutamp",
    **dict.fromkeys(("prior_moments", "rank_one_fit", "mc_prior_mse", "rank_one_se"), "rank_one"),
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)


class _Solvers(types.ModuleType):
    """The package, with the three functions that share their module's name
    as properties: importing the module (which sets the package attribute)
    leaves the name bound to the function."""


for _name in ("bigamp", "pbigamp", "hutamp"):
    setattr(_Solvers, _name, property(lambda self, n=_name: getattr(importlib.import_module(f"{__name__}.{n}"), n),
                                      lambda self, value: None))
sys.modules[__name__].__class__ = _Solvers
