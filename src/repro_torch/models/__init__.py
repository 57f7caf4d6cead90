"""The dense decoder-only LM: config, layers, RoPE, attention and the
transformer, mirroring the JAX package's ``repro.models`` for the serving
path (prefill and decode)."""
