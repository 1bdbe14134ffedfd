"""Per-read tool decisions on tensors."""
