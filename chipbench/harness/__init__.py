"""The harness: cells found by name, the wall clock, set-up, the
measured window, the check against the plain reference, the result."""
