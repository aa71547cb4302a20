"""Deployment of the port: the cog-style ``predict.Predictor`` and a
Dockerfile beside it."""
