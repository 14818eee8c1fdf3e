"""The plain reference that judges the program's answers."""
