"""Frozen arithmetic: the card's peaks and each port kernel's necessary
operations and bytes, one file per kernel family (``families/``); a
model's useful FLOPs are its architecture module's (``chipbench/archs/``)."""
