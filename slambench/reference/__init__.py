"""The plain reference the benchmark's check compares the program with."""
