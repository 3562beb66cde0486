"""The systems under test, one module a kind of program, found by the name
a configuration file gives under `"system"` (`harness/spec.system`).

A system module provides:

- `build(conf, seed, device) -> harness.program.Handlers`: the program
  built from the configuration `conf` with the weights of run `seed`,
  drawn on `device`; `dit` is the `AceStepHandler` every render goes
  through (the one `harness.program.Recorder` wraps), `llm` an
  `LLMHandler` or None;
- `install(rec, handlers)`: the system's own wrappers added to the run's
  `Recorder` (after its own `install`); it may do nothing;
- `warm(handlers, mix, seed, out_dir)`: every shape the traffic mix uses
  run once, before the window;
- `judge(conf, seed, records, songs, device, k, renders) -> dict`: once
  the window has closed and the program's state is freed, the numbers
  `correct` compares with `limits/<cell>.json` (each at or under its
  limit), and `sampled`, the count of requests judged;
- `request_flops(conf, rec) -> float`: the analytic FLOPs of one
  completed request (`rec` as `harness/drivers._record` makes it), which
  `mfu_pct` sums over the window.
"""
