"""One reader per metric, `<metric name>.py`, each with read(rec): the
metric's value from the run's record, or None where the record holds
nothing for it (run.py `run_cell` says what the record holds)."""
