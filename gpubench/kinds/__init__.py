"""The traffic kinds, one module a kind, found by the ``kind`` of a traffic
mix's file (``traffic/<mix>.json``), whose other keys are the kind's
parameters.  A kind gives:

* ``inputs(cell, seed, device) -> data``: the graph or samples drawn from
  the seed, with ``pool`` (the batches in turn), ``sizes`` (each batch's
  real nodes and edges), ``nodes_per_step`` (the nodes in the loss) and
  ``stats``;
* ``program_batches(cell, data, prog, prog_cell) -> list``: each batch of
  the pool in the program's layout, by ``prog`` (``program/<arch>.py``)
  for the program's train cell ``prog_cell``;
* ``ref_batch(data, i, device) -> dict``: the reference's batch ``i``,
  unpadded.
"""
