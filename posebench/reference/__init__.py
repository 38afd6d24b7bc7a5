"""The plain reference of the benchmark: the DINOv2 pose model, its training
step and its serving path in float32 PyTorch (TF32 off), or with every
product's operands in fp8 for the control. It imports nothing of the
program under test and takes nothing the program made."""
