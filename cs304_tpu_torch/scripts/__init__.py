"""The port's command line: one module for each project script, run as
``python -m cs304_tpu_torch.scripts.<name>``. Options, defaults and printed
lines are the JAX package's scripts' (``scripts/``), except that
``--device`` (the card by default; ``cpu`` for the CPU) takes the place of
``--platform``. Each script's ``main(argv=None)`` parses ``argv`` (the
command line when None), so a caller can run it in process."""
