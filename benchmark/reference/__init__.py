"""Plain PyTorch references that decide `correct`. They import nothing of
the program and take nothing it made: only the benchmark's own inputs and
weights, and the program's answers, which they judge."""
