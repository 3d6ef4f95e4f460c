"""Analytic cost accounting and the roofline of the dry run (the port of ``repro.analysis``)."""
