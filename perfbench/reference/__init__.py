"""Plain PyTorch and NumPy versions of what the timed path computes.

They import nothing of the program and take nothing it made: weights come
from ``perfbench.weights``, frames from ``perfbench.world``, and every
table (the patch projection, the tokenizer's ids) is worked out here
again. Matrix products run in float32 with TF32 off, or, for a
configuration's control, in the precision just below the one it states.
"""
