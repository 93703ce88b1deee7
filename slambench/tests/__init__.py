"""CPU tests of the benchmark (`python -m pytest slambench/tests`)."""
