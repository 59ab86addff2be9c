"""One module a configuration, beside its file of sizes
(``<name>.json``), and its plain reference (``<name>_reference.py``).

A configuration's module gives the harness:

- ``leaves(config)`` and ``make_params(config, seed, device)``: the
  weights, made from the seed, in the model's order;
- ``build(config, traffic, params, device, world)``: the port's trainer
  built from those weights, as a ``harness.subject.Subject``;
- ``raw_grads(subject)``: the first step's gradient as the optimizer got
  it, from its state;
- ``reference(config, traffic, params, batches, world, precision)``: the
  plain reference's first steps;
- ``flops_per_image(config)``: the frozen forward count;
- ``layer_bounds(config, traffic, peak_flops, peak_bytes)``: the least
  time of each kernel layer's work a step, on one card;
- ``OP_RANGES``: the host ops whose device time is that layer's.
"""
