"""Evaluation of the port: orbit views, novel-view and visual metrics."""
