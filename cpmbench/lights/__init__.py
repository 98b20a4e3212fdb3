"""One module a light type, ``<type>.py``, found by the ``type`` of a
configuration's ``lights`` entry. Each has ``program(Light, spec)``, the
program's light of the entry ``spec`` built with the program's ``Light``
class, and ``reference(Light, spec)``, the reference's built with its
frozen copy. A reference light of a type that the reference's emission
does not know (it knows the directional) carries its own
``emit(samples, key=, box_min=, box_max=, iteration=)``."""
