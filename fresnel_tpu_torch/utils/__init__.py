"""Shared utilities: bf16 mixed precision (`precision`)."""
