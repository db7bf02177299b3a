"""Parameter resolution and text features shared by the entry points."""
