"""The model stack of the port: mamba2's SSM layers, grouped-query and
sliding-window attention, hymba's hybrid layers and the dense FFN, the
layer plan and the language model around them, with the parameter
converter from the JAX package's tree. Parameters are plain dictionaries of tensors; a
segment of identical layers is a list of per-layer dictionaries."""
