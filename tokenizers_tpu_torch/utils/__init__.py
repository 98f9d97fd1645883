"""Helpers of the port that stand apart from its pipelines."""
