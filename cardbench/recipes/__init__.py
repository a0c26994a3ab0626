"""How a configuration's solve is driven through the program, one file
per `recipe.kind`.  Each module gives:

- prepare(cfg, mix, device): the state a run holds (the program's
  operator and the solve's keywords);
- warm_up(state): a short run of the cell's own shapes and method;
- solve(state, x0, seed): one timed solve from start vector x0 (and
  `seed` for the recipe's own random draws); returns (out, spans), spans
  the benchmark's own host-clock spans inside it, in seconds;
- keep(out): (kept, history): what the reference judges, copied out of the
  program's buffers, and the program's counts of the solve;
- slice_parts(state, x0): the traced slice, a list of (name, fn), each fn
  running a bounded piece of the timed path and returning its Krylov
  steps and the units of work it did (see cardbench/roofline)."""
