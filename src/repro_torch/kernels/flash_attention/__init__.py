"""Blocked GQA attention forward (prefill): the flash-attention kernel."""
