"""The plain reference of the benchmark's comparisons (plain PyTorch; it
imports nothing of the program under test)."""
