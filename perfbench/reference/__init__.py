"""Plain references that judge the program's answers (no program code)."""
