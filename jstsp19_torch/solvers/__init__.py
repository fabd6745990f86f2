"""Solvers: the soft threshold, SVT, the proposed ADMM, the baselines LS,
MMV-OMP and VAMP, the scalar estimators, and the GAMP core (``gamp_est``,
``gamp``, ``amp``, ``fista``, ``sure_amp``)."""
