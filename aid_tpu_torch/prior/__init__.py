"""Coefficient selection: the Beta-prior explore-and-select and the Bayesian (alpha, beta) search."""
