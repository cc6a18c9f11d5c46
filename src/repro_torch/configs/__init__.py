"""Model configurations of the port, as the reference's ``configs``
publishes them (the port's own copies: the reference's package imports its
MoE layer)."""
