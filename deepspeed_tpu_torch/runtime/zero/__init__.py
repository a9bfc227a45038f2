"""ZeRO: the configuration, the partition plan and the engine's per-unit state."""
