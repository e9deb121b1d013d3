"""Federated training: the feel-mlp model and the trajectory engine."""
