"""Plain PyTorch reference of what the benchmark's cells compute.

It imports nothing of `tepose_tpu_torch` and takes no tensor the program
made: the benchmark hands it the same raw weights and inputs it hands the
program, and the program's outputs only to judge them.
"""
