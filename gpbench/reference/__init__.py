"""The yardstick: the plain reference of the step and the byte counter."""
