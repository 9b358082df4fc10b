"""Plain PyTorch references of the benchmark's configurations.

They import nothing of the port and take nothing it made: only the inputs
the benchmark generated and the outputs being judged. ``Precision`` selects
the arithmetic: float64 for the reference itself, float32 with every matrix
product's operands rounded to TF32 for the control.
"""
