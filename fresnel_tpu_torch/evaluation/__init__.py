"""Evaluation helpers of the port: orbit views so far."""
