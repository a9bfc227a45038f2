"""ZeRO configuration (placement over more than one process is a later slice)."""
