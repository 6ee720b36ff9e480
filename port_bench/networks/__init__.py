"""The benchmark's networks, one generator a module: ``<name>.py`` defines
``draw(T, n, seed, device, **params)``, the network (T, n, n) uint8 on
``device``; a configuration names its generator and parameters under
``"network"`` (``"generator"`` and the rest)."""
