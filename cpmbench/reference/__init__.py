"""The benchmark's plain reference: frozen copies of the port's plain
forms (the wavefront trace, the plain product splat, the plain sweep loop,
the importance and selection code, the threefry streams and emission) and
:mod:`cpmbench.reference.pipeline`, which composes them. Nothing here
imports the program; docstrings keep the port's pointers into the JAX
package's sources."""
