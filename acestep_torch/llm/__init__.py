"""The 5 Hz LM planner: tokenizer, constrained decoding, engine, handler."""
