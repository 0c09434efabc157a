"""Command lines with the reference's flags and output: ``solve`` (the
reference's ``gmres_perf_test``) and ``condest_cli`` (its ``condest``)."""
