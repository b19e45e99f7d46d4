"""Scene builders, one file a scene, found by the ``scene`` key of a configuration
file: ``build(config) -> RawScene``, and for an animated scene
``animate(scene, delta)``.  Later changes add a file here for a new scene and
never edit one that is here."""
