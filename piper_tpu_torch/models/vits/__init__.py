"""VITS inference in PyTorch over plain parameter trees (nested dicts /
lists of tensors in the JAX package's layouts); NWC activations."""
