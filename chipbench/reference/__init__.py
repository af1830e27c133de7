"""The plain reference: Qwen3 and Qwen3-MoE in float32 with TF32 off,
and the comparisons that decide ``correct``.  Imports nothing of the
program."""
