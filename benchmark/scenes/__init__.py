"""Scene recipes of the benchmark's configurations, found by the name in a
configuration's ``scene.recipe``: ``benchmark/scenes/<recipe>.py`` with a
``make(spec, seed, device, dtype) -> (scene, camera)`` of plain tensors."""
