"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` on the card.  Everything that
belongs to one configuration, traffic mix or per-layer metric is a file of
its own that the harness finds by name:

  * ``configs/<config>.json``    the model's sizes as run (``family`` names
                                 the reference and the system adapter);
                                 its tables as ``emb_num`` rows in each of
                                 ``n_tables``, or ``vocab_sizes``, a list
                                 of each table's rows; ``pooling`` one bag
                                 length, or a list of one a table.  Where
                                 every bag has one length L a batch's
                                 ``indices`` and ``weights`` are (items,
                                 T, L); otherwise (items, sum L_t), table
                                 t's bag in the columns
                                 ``loadgen.bag_edges(cfg)[t:t + 2]``;
  * ``traffic/<traffic>.json``   parameters of the one general generator
                                 (``loadgen.py``);
  * ``limits/<cell>.json``       each compared number's limit and the
                                 readings it was set from;
  * ``metrics/<metric>.py``      a reader: ``read(ctx) -> float | None``;
  * ``reference/<family>.py``    the plain PyTorch reference, the inputs it
                                 shares with the system, and the operation
                                 and byte counts;
  * ``systems/<family>.py``      the system under test, built from the port.

``control.py`` puts the reference, one precision down, in the system's
place; ``calibrate.py`` reads the program and the control for the limits.
"""
