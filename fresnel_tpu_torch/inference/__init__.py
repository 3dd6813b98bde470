"""Inference of the port: CVS multi-view generation and its 3DGS fit."""
