"""Plain references of the benchmark: plain torch, independent of the program."""
