"""A directional light: ``{"type": "directional", "direction": [x, y, z]}``
with an optional ``radiance``."""


def _make(Light, spec: dict):
    return Light.directional(spec["direction"],
                             tuple(spec.get("radiance", (1.0, 1.0, 1.0))))


program = reference = _make
