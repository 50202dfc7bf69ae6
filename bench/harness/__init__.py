"""The harness: finds a cell's files by name, builds its inputs from the
seed, drives the port's public entries, times them and checks what they
produced against ``bench/reference``."""
