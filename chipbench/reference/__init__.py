"""The plain references, one module an architecture (``qwen3``: Qwen3
and Qwen3-MoE), in float32 with TF32 off; the training path's steps
(``train``) and the comparisons that decide ``correct``.  Imports
nothing of the program."""
