"""Static checks the port's search path runs: ArchSpec lint."""
