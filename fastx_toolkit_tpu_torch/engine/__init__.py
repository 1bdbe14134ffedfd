"""Fused-chain decisions, host tie fixes and the streaming line engine."""
