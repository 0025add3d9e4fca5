"""One module a traffic kind (a traffic file's ``loop``): ``run(cell)``
sets the cell up, runs its window and compares its outputs, and returns a
``harness.Outcome``."""
