"""A configuration's job, run through the program: ``jobs/<job>.py`` defines
``Job(config, data, device, spans)``, which takes the benchmark's data
(``datagen.CellData``) and hands host copies to the program, and

- ``build()``: the program's layouts (set-up);
- ``warm_up()``: the job's path once, every shape of the window;
- ``run() -> record``: one job; ``summary(record)``: a line for the log;
- ``answers(record)``: a record's answers as plain numbers, and
  ``last_answers()``: the last job's coefficients (``reference/judge.py``
  reads both);
- ``fe_iterations(record)``, ``model_work(record)``: what the per-layer
  readers count (a traced run; ``trace_on()`` first, where a job collects
  more when traced);
- ``free()``: drop the program's state before the reference runs.
"""
