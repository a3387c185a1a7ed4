"""The plain references that decide ``correct``: torch and numpy only,
nothing of the program."""
