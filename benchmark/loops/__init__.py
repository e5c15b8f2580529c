"""Traffic loops: one module per way of driving the program (serving
requests, fitting a scene, training the predictor).  A traffic mix file
names its loop with `loop`; each loop module has

  setup(cell, seed, device, tracer, spans) -> state   (everything before
      the window, warm-up included; counted as set-up)
  window(state, seconds, run) -> dict                  (the measured window:
      the end-to-end values and the attempted / failed counts)
  check(state, run) -> harness.Checks                  (the program's state
      freed, then the comparison with the reference that decides `correct`)
"""
