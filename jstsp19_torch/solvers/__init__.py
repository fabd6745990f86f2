"""Solvers: the soft threshold, SVT, the proposed ADMM, and the baselines LS,
MMV-OMP and VAMP with its estimators."""
