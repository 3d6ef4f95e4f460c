"""One-token GQA attention over a KV cache: the decode-attention
kernel."""
