"""Traffic kinds: one module per way of driving the program.

A traffic file's ``kind`` names its module here. Each module has
``setup(cell, seed, device) -> Work``; a ``Work`` holds one cell's inputs,
made from the seed, and has:

* ``call()``: one call of the program's entry, closed loop, returning its
  loop rows as ``[(key, q, scale)]``;
* ``reference(device, dtype, tf32)``: the plain reference's rows for the
  same inputs, in the same form;
* ``mb_per_call``: chromosome megabases one call finishes;
* ``fused_flop``, ``fused_bytes``: what the fused ladder kernel needs per
  call (``harness/flops.py``);
* ``trace_extra()``: anything beside the trace that a per-layer reader
  takes (the CLI's phase log);
* ``close()``: drop what it holds and remove what it wrote.
"""
