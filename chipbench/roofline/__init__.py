"""Frozen arithmetic: the card's peaks, each port kernel's necessary
operations and bytes, and the model's useful FLOPs."""
