"""The steps a traffic mix may name, one module a step, ``<op>.py``, found
by the step's ``op``. A module holds:

- ``run(s, step, ctx, record)``: the step on the session ``s``
  (:class:`cpmbench.harness.session.Session`) with its parameters
  ``step.params`` and what it keeps between interactions ``step.mem``;
  ``ctx`` carries what one step hands the next within an interaction.
  Inputs are drawn from ``s.draws``. The side's own calls go through
  ``s.on(program, reference)``, the module's two forms of the step: the
  program's entry points (``side.step``, ``side.config``) and the plain
  reference's (``side.P``, ``side.config``, the precision ``side.p``).
  Where ``record`` is not None it appends ``(op, fields)`` for the check;
- ``check(c, fields)``, if the step produces something to compare: the
  reference (``c.ref``, exact) works it out again from the same inputs
  and ``c.note``\\ s each number compared;
- ``final(c, step, state)``, if a number needs the window's last state;
- ``setup(s, step)``, if the step needs work before the window.
"""
