"""One module a timed path of the program, found by the name a cell's
file gives (vadbench/workloads/<cell>.json, "driver"). Each defines
`Driver(run)` with:

  setup()        inputs and weights from the seed, the program's objects,
                 the warm-up of every shape the window uses;
  step()         one closed-loop unit of the window, returning
                 {"ok", "work": {...}, ...};
  end_to_end(steps, window_s) -> {metric: value};
  trace_hooks()  a context manager yielding the dict its per-layer
                 records go into while the traced window runs;
  release()      frees the program's state before the reference runs;
  check(control) -> {compared number: reading}: the program's outputs
                 (with control=True the reference in TF32 in their place)
                 against the float32 reference.
"""
