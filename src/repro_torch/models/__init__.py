"""The model substrate (the port of ``repro.models``): layers, attention
over the two attention kernels, the Mamba mixer, the MoE layer, and the
transformer stack."""
