"""The port's benchmark: ``python3 -m gpbench.run`` (see ``run.py``)."""
