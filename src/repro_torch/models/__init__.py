"""The decoder-only LM: config, layers, RoPE, attention, the MoE and
Mamba blocks and the transformer that stacks them, mirroring the JAX
package's ``repro.models`` (training, prefill and decode)."""
