"""Step kinds: what one step of a traffic mix does, one module per kind.

A module ``<kind>`` defines ``Step(inputs, cfg, traffic, seed)``: the
program under test set up on the inputs (the operator the benchmark
built), with

* ``describe()``: a few numbers of the inputs, for the set-up line;
* ``run(i)``: step ``i`` of the window (its answers kept for the judge,
  earlier state released first); returns per-step numbers;
* ``work()``: after the window, each step's FLOPs by the frozen counts;
* ``judge()``: after the window, with the program's state released,
  ``(numbers, attempted, failed)``: the numbers the reference compares
  with the cell's limits, the answers due and the answers that failed.
"""
