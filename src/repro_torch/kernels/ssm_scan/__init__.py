"""Mamba-1 selective scan over a sequence: the ssm_scan kernel."""
