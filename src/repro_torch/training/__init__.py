"""Training: AdamW with float32 master weights and the train step."""
