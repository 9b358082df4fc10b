"""Closed loops, one a kind of traffic, named by a traffic file's
``loop`` key. Each has ``setup(ctx)`` (inputs from the seed, the program's
warm-up of this cell's shapes), ``step(state, i)`` (one unit of the loop,
ending in a synchronisation, as a dict with ``lanes`` and ``ok``),
``finish(units)`` (reads each unit's counts after the window),
``check(state, units, rng)`` (frees the program's state, then the numbers
compared with the plain reference) and ``control(state, units, rng)`` (the
same numbers for the reference in the control's precision standing in for
the program)."""
