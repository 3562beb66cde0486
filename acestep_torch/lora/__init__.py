"""LoRA / LoKr adapters for the DiT decoder: the adapter math and the
`.npz` adapter files, in the JAX package's layout so files move between
the two packages unchanged."""
