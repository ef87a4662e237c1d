"""Load generators, one a file, found by the name a traffic mix gives
(see :mod:`gpbench.load`)."""
