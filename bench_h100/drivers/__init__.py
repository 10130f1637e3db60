"""Drivers: the code that makes a traffic mix's inputs and drives the
program with them. A traffic file names its driver; every shape the driver
uses comes from that file and the configuration, and the run's seed draws
only values.

A driver module defines `Cell(config, traffic, seed, device)` with:

  warm_unit()        one unit of the cell's traffic (a call, a chunk, a tick);
  window(seconds)    the measured window: {"metrics", "attempted", "failed"};
  traced_slice()     a bounded steady slice for the profiler; returns what
                     the metric readers count: {"units", ...};
  free_program()     drop the program's state once the window has closed;
  judged()           the program's outputs that are compared;
  reference_outputs(reference)  the reference's on the same inputs.
"""
