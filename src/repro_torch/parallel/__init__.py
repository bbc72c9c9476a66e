"""Parallelism plan (the port of ``repro.parallel``): ``sharding`` (logical
axes to mesh axes, with divisibility fallbacks), ``constraints``
(activation hints threaded through a context variable) and ``spec`` (the
spec form both share, and its DTensor placements). DTensor's rules for
the ops it lacks are registered where meshes are built
(``launch.mesh``).
"""
