"""The training substrate (the port of ``repro.train``): AdamW, gradient
accumulation and int8 compression, the data streams, ZNS-mirrored
checkpoints and the fault-tolerant loop."""
