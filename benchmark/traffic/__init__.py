"""Traffic kinds. A mix (traffic/<mix>.json) names its kind in "kind"; the
module traffic/<kind>.py has ``drive(cell)``, which runs one cell whole:
``cell`` has cfg, mix, seed, seconds, trace, device and controls (the lower
precisions of the reference to read beside the program). It builds the
system from the seed, warms up, drives the window, reads the peak memory,
frees the program and gathers the check's numbers, and returns a dict:

  * ``t_start``: when the window began (perf_counter), which ends set-up;
  * ``e2e``: every end-to-end metric the kind measures, by name;
  * ``obs``: what the per-layer readers (metrics/<metric>.py) read;
  * ``info``: counts for the run's earlier result line;
  * ``peaks``: each card's peak allocated bytes over set-up and window,
    one entry per card the run used (on the CPU, [0]);
  * ``attempted``, ``failed``: requests due in the window, and those that
    did not come back whole;
  * ``numbers``: the compared numbers by candidate (check.py), "program"
    with the exact counts.

A new kind is a new module and mix files, with no edit to run.py.
"""
