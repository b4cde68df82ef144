"""The benchmark's plain reference: what the timed path must compute,
written out again in plain PyTorch.

It imports neither JAX nor anything of the program, and takes nothing
the program made: the inputs come from the benchmark, and every table,
weight and selection the program derives from them is worked out here
again. It is a frozen copy of the published semantics (the UNet forward,
the loss and the optimiser, the static selection and extraction, the MAD
flags), not a call into the program's plain versions.

Each function takes ``q``, a rounding applied to the intermediate
tensors: None for the reference itself, a lower precision
(:mod:`.precision`) for the control that the comparison must reject.
"""
