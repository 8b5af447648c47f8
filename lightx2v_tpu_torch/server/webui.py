"""Built-in web UI (counterpart of ``lightx2v_tpu.server.webui``): a
dependency-free single-page app over the /v1/tasks API, served at ``/``:
t2v and i2v with conditioning-image upload, attention and quant pickers
filled from /v1/service/metadata, memory-based auto-config, the caching,
tiny-VAE, tiled-VAE and offload toggles, resolution, steps and CFG controls,
progress polling, inline playback, the model/task matrix, and a download of
the effective config JSON (replayable with ``infer.py --config_json``).
"""

WEB_UI_HTML = """<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>lightx2v_tpu_torch</title>
<style>
  body { font-family: system-ui, sans-serif; max-width: 880px; margin: 2rem auto; padding: 0 1rem; background: #111; color: #eee; }
  h1 { font-size: 1.3rem; }  h1 span { color: #7ab8ff; }
  textarea, input, select { width: 100%; box-sizing: border-box; background: #1d1d1f; color: #eee;
                    border: 1px solid #333; border-radius: 6px; padding: .55rem; margin: .25rem 0 .75rem; }
  textarea { min-height: 4.5rem; }
  button { background: #2563eb; color: white; border: 0; padding: .6rem 1.4rem; border-radius: 6px;
           cursor: pointer; font-size: 1rem; margin-right: .5rem; }
  button.secondary { background: #374151; }
  button:disabled { background: #444; }
  #status { margin: 1rem 0; color: #9a9; min-height: 1.4rem; }
  video { width: 100%; border-radius: 8px; margin-top: 1rem; }
  .row { display: flex; gap: 1rem; } .row > div { flex: 1; }
  details { background: #17171a; border: 1px solid #2a2a2e; border-radius: 8px; padding: .6rem 1rem; margin: .75rem 0; }
  summary { cursor: pointer; color: #7ab8ff; }
  label.chk { display: inline-flex; align-items: center; gap: .4rem; margin-right: 1.2rem; }
  label.chk input { width: auto; margin: 0; }
  .pill { display: inline-block; background: #1e293b; color: #93c5fd; border-radius: 999px;
          padding: .1rem .6rem; margin: 0 .3rem .3rem 0; font-size: .8rem; }
  .pill.off { color: #777; background: #1a1a1d; }
  #devinfo { color: #888; font-size: .85rem; margin-bottom: .6rem; }
</style>
</head>
<body>
<h1><span>lightx2v</span>_tpu_torch &mdash; video generation</h1>
<div id="devinfo"></div>

<div class="row">
  <div><label>Task</label>
    <select id="task" onchange="onTask()">
      <option value="t2v">text &rarr; video</option>
      <option value="i2v">image &rarr; video</option>
    </select></div>
  <div><label>Resolution</label>
    <select id="resolution">
      <option>832x480</option><option>480x832</option><option>960x544</option>
      <option>544x960</option><option>1280x720</option><option>720x1280</option>
    </select></div>
  <div><label>Video length (frames)</label><input id="frames" type="number" value="81"></div>
</div>

<div id="i2vrow" style="display:none">
  <label>Conditioning image</label>
  <input id="image" type="file" accept="image/*">
</div>

<label>Prompt</label>
<textarea id="prompt" placeholder="A red panda surfing a wave at sunset..."></textarea>
<label>Negative prompt</label>
<input id="negative" placeholder="blurry, low quality">

<div class="row">
  <div><label>Seed <a href="#" onclick="randSeed();return false" style="color:#7ab8ff">&#x1f3b2;</a></label>
    <input id="seed" type="number" value="42"></div>
  <div><label>Steps</label><input id="steps" type="number" placeholder="config default"></div>
  <div><label>CFG scale</label><input id="cfg" type="number" step="0.5" placeholder="config default"></div>
  <div><label>FPS</label><input id="fps" type="number" placeholder="config default"></div>
</div>

<details id="adv">
  <summary>Advanced (kernels, quantization, offload, caching)</summary>
  <div id="ops"></div>
  <div id="matrix"></div>
  <div class="row">
    <div><label>Attention kernel</label><select id="attn"></select></div>
    <div><label>DiT quantization (load-time; changing it requires a relaunch)</label><select id="quant"></select></div>
  </div>
  <div>
    <label class="chk"><input type="checkbox" id="cfgon" checked> CFG</label>
    <label class="chk"><input type="checkbox" id="retsteps"> Cache ret-steps</label>
    <label class="chk"><input type="checkbox" id="tinyvae"> Tiny VAE</label>
    <label class="chk"><input type="checkbox" id="tilingvae"> Tiled VAE</label>
    <label class="chk"><input type="checkbox" id="offload"> Host-RAM streaming</label>
    <label class="chk"><input type="checkbox" id="lazyload"> Disk tier (lazy)</label>
  </div>
  <div class="row">
    <div><label>Feature caching</label>
      <select id="caching"><option>NoCaching</option><option value="Tea">TeaCache</option>
        <option value="TaylorSeer">TaylorSeer</option><option value="Ada">AdaCache</option>
        <option value="Custom">Custom (Tea+Taylor)</option></select></div>
    <div><label>TeaCache threshold</label><input id="teathresh" type="number" step="0.01" value="0.26"></div>
    <div><label>Sample shift</label><input id="shift" type="number" step="0.5" placeholder="config default"></div>
  </div>
  <div class="row">
    <div style="align-self:end"><button class="secondary" onclick="autoConfig()">Auto-configure for this device</button></div>
    <div style="align-self:end"><button class="secondary" onclick="downloadConfig()">Download config JSON</button></div>
  </div>
</details>

<button id="go" onclick="submitTask()">Generate</button>
<button class="secondary" onclick="stopTask()">Stop</button>
<div id="status"></div>
<div id="result"></div>

<script>
let META = null;
const QUANT_MM = {
  "bf16": "Default",
  "int8": "W-int8-channel-sym-A-int8-channel-sym-dynamic-Tpu",
  "fp8": "W-fp8-channel-sym-A-fp8-channel-sym-dynamic-Tpu",
  "fp8_block128": "W-fp8-block128-sym-A-fp8-channel-group128-sym-dynamic-Tpu",
  "int4": "W-int4-group-sym-A-bf16-Tpu",
};

function onTask() {
  document.getElementById('i2vrow').style.display =
    document.getElementById('task').value === 'i2v' ? '' : 'none';
}

async function loadMeta() {
  try {
    META = await (await fetch('/v1/service/metadata')).json();
  } catch (e) { return; }
  const d = META.device || {};
  document.getElementById('devinfo').textContent =
    `backend=${d.backend} devices=${d.device_count}` +
    (d.hbm_gb ? ` hbm=${d.hbm_gb}GB` : '') +
    (d.host_ram_gb ? ` host=${d.host_ram_gb}GB` : '');
  const ops = document.getElementById('ops');
  ops.innerHTML = (META.attention_ops || []).map(
    ([n, ok]) => `<span class="pill ${ok ? '' : 'off'}">${n}${ok ? '' : ' (fallback)'}</span>`).join('');
  const attn = document.getElementById('attn');
  attn.innerHTML = (META.attention_ops || []).map(([n]) => `<option>${n}</option>`).join('');
  const quant = document.getElementById('quant');
  quant.innerHTML = (META.quant_schemes || []).map(([n]) => `<option>${n}</option>`).join('');
  if (META.active_quant_scheme) quant.value = META.active_quant_scheme;
  // model-class / task capability matrix (reference app model dropdown);
  // highlight the server's loaded model and filter the task picker to
  // what that model class actually supports
  const matrix = document.getElementById('matrix');
  matrix.innerHTML = (META.model_matrix || []).map(m =>
    `<span class="pill ${m.model_cls === META.model_cls ? '' : 'off'}">${m.model_cls}: ${m.tasks.join('/')}</span>`).join('');
  const active = (META.model_matrix || []).find(m => m.model_cls === META.model_cls);
  if (active) {
    const taskSel = document.getElementById('task');
    const labels = {t2v: 'text \\u2192 video', i2v: 'image \\u2192 video', audio: 'audio \\u2192 video'};
    taskSel.innerHTML = active.tasks.map(t => `<option value="${t}">${labels[t] || t}</option>`).join('');
  }
  const def = META.defaults || {};
  if (def.seed != null) document.getElementById('seed').value = def.seed;
  if (def.infer_steps != null) document.getElementById('steps').placeholder = def.infer_steps;
  if (def.target_video_length != null) document.getElementById('frames').value = def.target_video_length;
  if (META.task) { document.getElementById('task').value = META.task; onTask(); }
}
loadMeta();

function randSeed() {
  document.getElementById('seed').value = Math.floor(Math.random() * 2147483647);
}

function autoConfig() {
  if (!META || !META.auto_config) return;
  const a = META.auto_config;
  document.getElementById('attn').value = a.attention_type;
  document.getElementById('quant').value = a.quant_scheme;
  document.getElementById('caching').value = a.feature_caching || 'NoCaching';
  document.getElementById('tinyvae').checked = !!a.tiny_vae;
  document.getElementById('tilingvae').checked = !!a.use_tiling_vae;
  document.getElementById('offload').checked = !!a.cpu_offload;
  document.getElementById('lazyload').checked = !!a.lazy_load;
  document.getElementById('status').textContent = 'auto-config applied for this device';
}

async function uploadImage() {
  const f = document.getElementById('image').files[0];
  if (!f) return null;
  const name = encodeURIComponent(f.name.replace(/[^\\w.\\-]/g, '_'));
  const r = await fetch('/v1/files/upload?name=' + name, {method: 'POST', body: f});
  if (!r.ok) throw new Error('image upload failed');
  return (await r.json()).path;
}

async function stopTask() {
  await fetch('/v1/tasks/running', {method: 'DELETE'});
}

function buildBody() {
  const res = document.getElementById('resolution').value.split('x');
  const options = {
    attention_type: document.getElementById('attn').value || undefined,
    self_attn_1_type: document.getElementById('attn').value || undefined,
    // quantization is a load-time property: send mm_type only when
    // the user picked a scheme other than the server's active one —
    // the server rejects the task with a clear message rather than
    // silently generating under the loaded scheme
    mm_type: (document.getElementById('quant').value !== (META && META.active_quant_scheme)) ?
      QUANT_MM[document.getElementById('quant').value] : undefined,
    feature_caching: document.getElementById('caching').value !== 'NoCaching' ?
      document.getElementById('caching').value : undefined,
    teacache_thresh: parseFloat(document.getElementById('teathresh').value),
    use_ret_steps: document.getElementById('retsteps').checked || undefined,
    enable_cfg: document.getElementById('cfgon').checked ? undefined : false,
    tiny_vae: document.getElementById('tinyvae').checked || undefined,
    use_tiling_vae: document.getElementById('tilingvae').checked || undefined,
    weight_streaming: document.getElementById('offload').checked || undefined,
    cpu_offload: document.getElementById('offload').checked || undefined,
    lazy_load: document.getElementById('lazyload').checked || undefined,
    target_width: parseInt(res[0]), target_height: parseInt(res[1]),
  };
  const cfgScale = document.getElementById('cfg').value;
  if (cfgScale) options.sample_guide_scale = parseFloat(cfgScale);
  const shift = document.getElementById('shift').value;
  if (shift) options.sample_shift = parseFloat(shift);
  const fps = document.getElementById('fps').value;
  if (fps) options.fps = parseInt(fps);
  const body = {
    prompt: document.getElementById('prompt').value,
    negative_prompt: document.getElementById('negative').value,
    seed: parseInt(document.getElementById('seed').value || '42'),
    target_video_length: parseInt(document.getElementById('frames').value || '81'),
    options,
  };
  const steps = document.getElementById('steps').value;
  if (steps) body.infer_steps = parseInt(steps);
  return body;
}

function downloadConfig() {
  // effective-config export: what the UI would submit, plus the server's
  // identity — replayable offline via infer.py --config_json (the
  // reference app's config save path)
  const body = buildBody();
  const cfg = Object.assign({}, body.options);
  delete cfg.mm_type;  // load-time; keep only if explicitly changed
  if (body.options.mm_type) cfg.mm_type = body.options.mm_type;
  cfg.prompt = body.prompt; cfg.negative_prompt = body.negative_prompt;
  cfg.seed = body.seed; cfg.target_video_length = body.target_video_length;
  if (body.infer_steps) cfg.infer_steps = body.infer_steps;
  if (META) { cfg.model_cls = META.model_cls; cfg.task = document.getElementById('task').value; }
  Object.keys(cfg).forEach(k => cfg[k] === undefined && delete cfg[k]);
  const blob = new Blob([JSON.stringify(cfg, null, 2)], {type: 'application/json'});
  const a = document.createElement('a');
  a.href = URL.createObjectURL(blob);
  a.download = 'lightx2v_tpu_config.json';
  a.click();
  URL.revokeObjectURL(a.href);
}

async function submitTask() {
  const btn = document.getElementById('go');
  const status = document.getElementById('status');
  const result = document.getElementById('result');
  btn.disabled = true; result.innerHTML = '';
  try {
    const body = buildBody();
    if (document.getElementById('task').value === 'i2v') {
      status.textContent = 'uploading image...';
      const p = await uploadImage();
      if (!p) throw new Error('i2v needs a conditioning image');
      body.image_path = p;
      body.options.task = 'i2v';
    }
    const r = await fetch('/v1/tasks', {method: 'POST', headers: {'Content-Type': 'application/json'},
                                        body: JSON.stringify(body)});
    const task = await r.json();
    if (!r.ok) throw new Error(JSON.stringify(task));
    status.textContent = 'task ' + task.task_id + ': queued...';
    let st;
    for (;;) {
      await new Promise(res2 => setTimeout(res2, 3000));
      st = await (await fetch('/v1/tasks/' + task.task_id + '/status')).json();
      status.textContent = 'task ' + task.task_id + ': ' + st.status;
      if (st.status === 'completed' || st.status === 'failed') break;
    }
    if (st.status === 'failed') throw new Error(st.error || 'generation failed');
    const out = await (await fetch('/v1/tasks/' + task.task_id + '/result')).json();
    // download_path is relative to the server's output root (keeps
    // subdirectories; a bare basename 404s for nested save paths)
    const rel = out.download_path || out.save_video_path.split('/').pop();
    result.innerHTML = '<video controls autoplay loop src="/v1/files/download/' +
      rel.split('/').map(encodeURIComponent).join('/') + '"></video>';
  } catch (e) {
    status.textContent = 'error: ' + e.message;
  } finally {
    btn.disabled = false;
  }
}
</script>
</body>
</html>
"""
