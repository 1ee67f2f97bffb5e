"""Plain PyTorch references, one module a model family, named by the
family (``moe.py``). Each takes the weights the benchmark
drew, by their names, and a configuration's sizes, and imports nothing of
the program: it recomputes the model from its equations in float32, with
TF32 off, or at a stated lower precision for the control."""
