"""Dependency-free browser UI served by the HTTP server at GET /.

Counterpart of cosyvoice_tpu/serving/web_page.py: one static page with the
reference webui's controls (mode, texts, speaker id, prompt audio, stream)
that drives the server's JSON endpoints and plays the chunked int16 PCM
through WebAudio as it arrives, at the model's sample rate.
"""

PAGE = """<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>cosyvoice_tpu_torch</title>
<style>
  body { font-family: system-ui, sans-serif; max-width: 720px; margin: 2rem auto; padding: 0 1rem; color: #222; }
  h1 { font-size: 1.3rem; }
  label { display: block; margin-top: .8rem; font-weight: 600; }
  textarea, input[type=text], select { width: 100%; box-sizing: border-box; padding: .4rem; margin-top: .2rem; }
  .row { display: flex; gap: 1rem; align-items: center; margin-top: .8rem; flex-wrap: wrap; }
  button { padding: .5rem 1.2rem; font-size: 1rem; cursor: pointer; }
  #status { margin-top: .8rem; color: #555; white-space: pre-wrap; }
</style>
</head>
<body>
<h1>cosyvoice_tpu_torch</h1>
<label>Mode
  <select id="mode">
    <option value="inference_zero_shot">zero-shot (prompt audio + transcript)</option>
    <option value="inference_cross_lingual">cross-lingual (prompt audio)</option>
    <option value="inference_instruct2">instruct2 (prompt audio + instruction)</option>
    <option value="inference_sft">sft (speaker id)</option>
    <option value="inference_instruct">instruct (speaker id + instruction)</option>
  </select>
</label>
<label>Text to synthesize <textarea id="tts_text" rows="3">Hello! This is a test of the CosyVoice2 PyTorch port.</textarea></label>
<label id="l_prompt_text">Prompt transcript <input type="text" id="prompt_text"></label>
<label id="l_instruct">Instruction <input type="text" id="instruct_text"></label>
<label id="l_spk">Speaker id <input type="text" id="spk_id"></label>
<label id="l_wav">Prompt audio (wav/pcm, 16 kHz) <input type="file" id="prompt_wav"></label>
<div class="row">
  <label style="margin:0"><input type="checkbox" id="stream"> stream</label>
  <button id="go">Synthesize</button>
  <button id="stop" disabled>Stop</button>
</div>
<div id="status"></div>
<script>
const SR = %SAMPLE_RATE%;
const $ = id => document.getElementById(id);
const needs = {
  inference_zero_shot: ["prompt_text", "wav"],
  inference_cross_lingual: ["wav"],
  inference_instruct2: ["instruct", "wav"],
  inference_sft: ["spk"],
  inference_instruct: ["spk", "instruct"],
};
function refresh() {
  const n = needs[$("mode").value];
  for (const f of ["prompt_text", "instruct", "spk", "wav"])
    $("l_" + f).style.display = n.includes(f) ? "" : "none";
}
$("mode").onchange = refresh; refresh();

let ctrl = null;
async function fileToB64pcm(file) {
  // decode via WebAudio, resample to 16 kHz mono, int16-encode
  const buf = await file.arrayBuffer();
  const ac = new OfflineAudioContext(1, 1, 16000);
  const audio = await ac.decodeAudioData(buf.slice(0));
  const oac = new OfflineAudioContext(1, Math.ceil(audio.duration * 16000), 16000);
  const src = oac.createBufferSource(); src.buffer = audio; src.connect(oac.destination); src.start();
  const out = (await oac.startRendering()).getChannelData(0);
  const i16 = new Int16Array(out.length);
  for (let i = 0; i < out.length; i++) i16[i] = Math.max(-1, Math.min(1, out[i])) * 32767;
  // chunked: spreading >~65k args into fromCharCode blows the JS stack
  const bytes = new Uint8Array(i16.buffer);
  let bin = "";
  for (let i = 0; i < bytes.length; i += 0x8000)
    bin += String.fromCharCode.apply(null, bytes.subarray(i, i + 0x8000));
  return btoa(bin);
}
let AC = null;  // one AudioContext for the page (Chrome caps live contexts)
$("go").onclick = async () => {
  const mode = $("mode").value, body = { tts_text: $("tts_text").value, stream: $("stream").checked };
  const n = needs[mode];
  try {
    if (n.includes("prompt_text")) body.prompt_text = $("prompt_text").value;
    if (n.includes("instruct")) body.instruct_text = $("instruct_text").value;
    if (n.includes("spk")) body.spk_id = $("spk_id").value;
    if (n.includes("wav")) {
      if (!$("prompt_wav").files[0]) throw new Error("prompt audio required");
      $("status").textContent = "encoding prompt...";
      body.prompt_audio_b64 = await fileToB64pcm($("prompt_wav").files[0]);
    }
    ctrl = new AbortController();
    $("go").disabled = true; $("stop").disabled = false;
    $("status").textContent = "synthesizing...";
    const t0 = performance.now();
    const resp = await fetch("/" + mode, {
      method: "POST", body: JSON.stringify(body), signal: ctrl.signal,
      headers: { "Content-Type": "application/json" },
    });
    if (!resp.ok) throw new Error(await resp.text());
    if (!AC) AC = new AudioContext({ sampleRate: SR });
    const ac = AC;
    let playhead = ac.currentTime + 0.1, total = 0, first = null, carry = new Uint8Array(0);
    const reader = resp.body.getReader();
    while (true) {
      const { done, value } = await reader.read();
      if (done) break;
      if (first === null) first = performance.now() - t0;
      const all = new Uint8Array(carry.length + value.length);
      all.set(carry); all.set(value, carry.length);
      const n16 = Math.floor(all.length / 2);
      const pcm = new Int16Array(all.buffer.slice(0, n16 * 2));
      carry = all.slice(n16 * 2);
      if (!pcm.length) continue;
      const ab = ac.createBuffer(1, pcm.length, SR);
      const ch = ab.getChannelData(0);
      for (let i = 0; i < pcm.length; i++) ch[i] = pcm[i] / 32768;
      const s = ac.createBufferSource(); s.buffer = ab; s.connect(ac.destination);
      playhead = Math.max(playhead, ac.currentTime + 0.05);
      s.start(playhead); playhead += ab.duration; total += ab.duration;
      $("status").textContent = `first chunk ${first.toFixed(0)} ms — ${total.toFixed(2)} s audio`;
    }
    $("status").textContent += "\\ndone.";
  } catch (e) {
    $("status").textContent = "error: " + e.message;
  } finally {
    $("go").disabled = false; $("stop").disabled = true; ctrl = null;
  }
};
$("stop").onclick = () => ctrl && ctrl.abort();
</script>
</body>
</html>
"""


def render(sample_rate: int = 24000) -> bytes:
    return PAGE.replace("%SAMPLE_RATE%", str(int(sample_rate))).encode()
