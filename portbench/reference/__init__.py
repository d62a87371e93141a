"""Plain references the benchmark's check compares the program with: plain
PyTorch, written from the published descriptions and the configuration
files, importing nothing of the program."""
