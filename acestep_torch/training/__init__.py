"""Training of the DiT: preprocessing, LoRA/LoKr fine-tuning and the
full-parameter step, ported from `acestep_tpu/training/`."""
