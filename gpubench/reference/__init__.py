"""Plain PyTorch references of the benchmark's models, with their FLOP and
byte formulas.

Nothing here imports the program.  Each architecture is a module named
after the program's architecture (``-`` as ``_``) that gives:

* ``layout(model)``: the weights as a tree of ``(shape, init, fan_in)``
  in the program's reference layout, which :func:`gpubench.harness.
  draw_weights` fills from the seed;
* ``loss(params, batch, model)``: the training loss of one batch (a dict
  of tensors, the unpadded graph or sample) in the dtype of ``params``;
* ``flops(model, n_nodes, n_edges)``: the model FLOPs of one training
  step (3x the forward, no recompute) on that many real nodes and edges;
* ``aggregate_bytes(model, n_nodes, n_edges)``: the bytes that the step's
  gathers and scatters must move at the least.

:mod:`.common` holds what they share: the tree walk, the message-passing
sums and the three reference steps of AdamW.
"""
