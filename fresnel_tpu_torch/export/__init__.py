"""Decoder export of the port: framework-neutral weights and a traced
module for the reference's C++ viewer."""
