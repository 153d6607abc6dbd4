"""Operation and byte counts of the kernels and the models, from shapes, and
the card's published peaks: the yardstick of every roofline and ``mfu``
metric."""
