"""Frozen copies of the port's measurement arithmetic.

Each module names the file of ``src/repro_torch`` (or the script) it was
copied from and the commit it was copied at. The benchmark reads only
these copies, so a later change to the port's own copies cannot move the
yardstick.
"""
