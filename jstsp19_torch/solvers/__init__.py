"""Solvers: the soft threshold, SVT and the SVT/ADMM matrix completions
(``mc_svt``, ``mc_admm``), the proposed ADMM, the baselines LS, OMP (``omp``,
``omp_gram``, ``omp_gram_kron``, the time-domain ``omp_td``, MMV-OMP) and
CoSaMP and VAMP, the scalar estimators, and the GAMP core (``gamp_est``,
``gamp``, ``amp``, ``fista``, ``sure_amp``)."""
