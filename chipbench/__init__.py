"""The port's benchmark: one command runs one cell (a model configuration
under one traffic mix) once and prints one JSON line.  See ``run.py``."""
