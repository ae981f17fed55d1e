"""The plain references the output check holds the program to."""
