"""The page-granular busy-clock timing model (the trace drivers' page
loop)."""
