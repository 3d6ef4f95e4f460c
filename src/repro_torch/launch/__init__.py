"""Entry points (the port of ``repro.launch``): batched serving."""
