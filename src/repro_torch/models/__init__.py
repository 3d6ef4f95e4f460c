"""The model substrate (the port of ``repro.models``): layers, attention
over the two attention kernels, and the dense transformer."""
