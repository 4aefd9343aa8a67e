"""Likelihood, linear algebra, kernels and the cutpoint ESS kernel wrapper."""
