"""Each architecture's count of a VMC step's work (``roofline.step_work``)
that ``roofline.py`` does not hold itself: ``<architecture>.py`` with a
``step_work(lattice, traffic, units)``."""
