"""Query kinds, one module per traffic ``"query"``. Each has:

- ``WEIGHTED``: whether the program's edge product reads a weight;
- ``LIMITS``: each number the check compares, with its limit;
- ``program(lanes)`` and ``params(keys)``: the port's program and the
  params of one call;
- ``reference(edges, keys)``: the plain answer, ``[n_vertices, lanes]``;
- ``CONTROLS`` / ``control(edges, keys, name)``: the reference run short
  of the guarantee the configuration states, for the control runs.
"""
