"""The benchmark's configurations: `<name>.json` holds the sizes as run,
`<name>.py` builds the graph through the port's public API and names the
plain reference of `reference/<name>.py`.

Every `<name>.py` has the same hooks, whatever driver calls them:
- `inputs(cfg, rng)`: the seeded data of a run, a dict with "clips", a
  list of (clip (C, n) float32, native rate), and any other pools;
- `settings(cfg, inputs, vary, rng, n)`: n instances' settings, a dict
  of n-long arrays; those that `vary` (a traffic's) names are drawn from
  `rng`, the rest keep the configuration's value;
- `prepare(wt, cfg, clip, rate)`: the port's preparation of a clip as
  the graph's source buffer, (C, L) float32 at the context's rate;
- `build(wt, cfg, inputs, device, frames, audio, one, batch)`: one graph
  of `frames` frames on `audio` with one instance's settings `one`;
  returns (context, nodes), nodes["source"] the buffer source; with
  `batch` every setting can be given per instance by `stage`;
- `stage(gb, nodes, cfg, settings, scratch)`: each instance's settings
  into a GraphBatch of that graph (`scratch` a dict the caller keeps);
- `reference(cfg, inputs, clips, settings, frames, precision)`: the
  plain reference's destination of each (clip, rate) of `clips` with its
  settings, (n, C, frames) float64, every operation rounded to
  `precision`.
"""
