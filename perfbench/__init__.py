"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that belongs to one configuration, one traffic mix
or one per-layer metric is a file of its own, found by the name
``BENCHMARK.json`` gives it:

  * ``configs/<config>.json``   the configuration as it is run;
  * ``traffic/<traffic>.json``  the parameters of a traffic mix, with the
    name of the driver (``drivers/<driver>.py``) that generates and runs it;
  * ``limits/<cell>.json``      the limits of the cell's correctness check;
  * ``metrics/<metric>.py``     the reader of one per-layer metric.

The yardstick lives here too: the Zipf generator (``zipf.py``), the byte
counts behind a roofline (``roofline.py``), the device's peaks
(``peaks.py``), the trace reduction (``trace.py``) and the plain
references (``reference/``), which import nothing of the program.
"""
